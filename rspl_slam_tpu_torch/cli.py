"""Command-line drivers of the port (port of cli.py), with the JAX
package's arguments and printed lines:

- ``run``: dataset directory → SLAM → TUM trajectory (+ optional map,
  text map and visualization dumps, ATE against ground truth, timings);
- ``serve``: live ingestion from a watched directory;
- ``batch``: several sequences → per-sequence ATE table;
- ``eval``: ATE of an estimate against a ground-truth TUM file;
- ``synth``: a synthetic sequence with known ground truth (``OracleFrontend``
  on the unfused tracking path);
- ``pretrain``: synthetic training of SuperPoint, RCF or SuperGlue
  (``training/``) → an ``.npz`` pytree that both packages load;
- ``convert-weights``: public ``.pth`` checkpoints → ``.npz`` pytrees.

``--device`` (``run``, ``serve``, ``batch``, ``synth``, ``pretrain``) picks the torch
device, the card by default; without one visible the run raises. ``run``
decodes and rectifies frames on the C++ threads of
``native.NativeStereoLoader`` (host code built at first use) and feeds
them to ``PipelinedRunner``; ``--no-native`` reads the dataset through
``EurocDataset`` instead and rectifies on the device inside the frontend.
Both routes decode to PIL's ``convert("L")``, so frames never depend on
``--no-native``. Images decode through ``png.py`` and ``native.py``,
configs parse without PyYAML, plots draw without matplotlib. The global
layer runs as in the JAX package: ``--loop-closure`` (``run``, ``serve``)
detects loops and relocalizes, ``--track-local-map`` re-associates by
projection at keyframes, and ``--pose-graph`` / ``--global-ba`` refine the
map at the end of a run.

Usage: ``python -m rspl_slam_tpu_torch.cli <command> [args]``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import threading
import time

import numpy as np

def _device(args):
    from rspl_slam_tpu_torch.frontend.frontends import resolve_device

    return resolve_device(args.device)


def _build_slam(args, use_lines=None, rectify=True):
    from rspl_slam_tpu_torch.config import load_system_config
    from rspl_slam_tpu_torch.frontend.frontends import NeuralFrontend
    from rspl_slam_tpu_torch.slam import SLAMSystem

    cfg = load_system_config(args.config, args.camera_config)
    if use_lines is not None:
        cfg = dataclasses.replace(cfg, use_lines=use_lines)
    # --sp-weights / --sg-weights / --rcf-weights override the config's paths
    if getattr(args, "sp_weights", None):
        cfg = dataclasses.replace(cfg, superpoint=dataclasses.replace(
            cfg.superpoint, weights_path=args.sp_weights))
    if getattr(args, "sg_weights", None):
        cfg = dataclasses.replace(cfg, superglue=dataclasses.replace(
            cfg.superglue, weights_path=args.sg_weights))
    if getattr(args, "rcf_weights", None):
        cfg = dataclasses.replace(cfg, line_detector=dataclasses.replace(
            cfg.line_detector, rcf_weights_path=args.rcf_weights))
    if getattr(args, "track_local_map", False):
        cfg = dataclasses.replace(cfg, pipeline=dataclasses.replace(
            cfg.pipeline, track_local_map=True))
    if getattr(args, "sync_ba", False):
        cfg = dataclasses.replace(cfg, pipeline=dataclasses.replace(
            cfg.pipeline, async_ba=False))
    fe = NeuralFrontend(cfg, matcher=getattr(args, "matcher", "superglue"),
                        rectify=rectify, lazy_right=getattr(args, "lazy_right", None),
                        device=_device(args))
    slam = SLAMSystem(cfg, fe, enable_loop_closure=getattr(args, "loop_closure", False))
    resume = getattr(args, "resume_map", None)
    if resume:
        slam.resume_from_map(resume)
        print(f"resumed from {resume}: {slam.map.n_kf} keyframes, "
              f"{slam.map.n_pt} mappoints")
    return slam, cfg


def _publisher(args, slam):
    """The per-frame pose stream and overlays of ``--viz-dir``, or None."""
    from rspl_slam_tpu_torch.visualization import FramePublisher

    if not args.viz_dir:
        return None
    slam.frontend.keep_images = True
    return FramePublisher(args.viz_dir, overlay_stride=args.overlay_stride)


def cmd_run(args):
    from rspl_slam_tpu_torch import native
    from rspl_slam_tpu_torch.camera import build_rectify_maps
    from rspl_slam_tpu_torch.datasets import open_dataset
    from rspl_slam_tpu_torch.pipeline import PipelinedRunner

    use_native = not args.no_native
    # the native prefetcher rectifies in its decode threads; the dataset
    # route rectifies on the device inside the frontend
    slam, cfg = _build_slam(args, use_lines=not args.no_lines, rectify=not use_native)
    # the card's dataset route unfilters PNG rows in the compiled host loop
    ds = open_dataset(args.dataroot, compiled=slam.device.type == "cuda")
    n = len(ds) if args.max_frames <= 0 else min(len(ds), args.max_frames)
    print(f"dataset: {args.dataroot} ({n} frames)")
    publisher = _publisher(args, slam)

    def _report(rec):
        if args.verbose and rec.frame_id % 50 == 0:
            print(f"frame {rec.frame_id}: kf={rec.is_keyframe} inliers={rec.num_inliers}")

    def on_record(rec, feats):
        if publisher is not None:
            publisher(rec, feats)
        _report(rec)

    loader = None
    if use_native:
        lefts, rights = ds.file_lists()
        map_l = build_rectify_maps(cfg.camera, "left")
        map_r = build_rectify_maps(cfg.camera, "right")
        if map_l is None or map_r is None:  # as the frontend: both eyes or neither
            map_l = map_r = None
        loader = native.NativeStereoLoader(lefts[:n], rights[:n], cfg.camera.image_height,
                                           cfg.camera.image_width, map_l=map_l, map_r=map_r,
                                           depth=cfg.pipeline.queue_depth)
        print("using native prefetcher" + (" + rectification" if map_l is not None else ""))

    t0 = time.perf_counter()
    try:
        if args.serial:
            # strictly serial loop (debugging / timing splits)
            if loader is not None:
                frames = ((i, ds.timestamp(i), il, ir) for i, il, ir in loader)
            else:
                frames = ((fr.index, fr.time, fr.image_left, fr.image_right)
                          for fr in (ds[i] for i in range(n)))
            for i, t, il, ir in frames:
                rec = slam.add_frame(i, t, il, ir)
                on_record(rec, slam._last_feats)
        elif loader is None:
            # prefetch ∥ extract ∥ track
            PipelinedRunner(slam, ds, queue_depth=cfg.pipeline.queue_depth,
                            on_record=on_record).run(max_frames=n)
        else:
            # the native decode threads are the prefetch stage
            runner = PipelinedRunner(slam, queue_depth=cfg.pipeline.queue_depth,
                                     on_record=on_record)
            failed = []

            def feeder():
                try:
                    for i, il, ir in loader:
                        runner.feed(i, ds.timestamp(i), il, ir)
                except Exception as e:  # surfaces after the runner drains
                    failed.append(e)
                finally:
                    runner.close_input()

            th = threading.Thread(target=feeder, daemon=True)
            th.start()
            runner.run_manual()
            th.join()
            if failed:
                raise failed[0]
    finally:
        if loader is not None:
            loader.close()
    wall = time.perf_counter() - t0
    print(f"processed {n} frames in {wall:.1f}s ({n / wall:.1f} fps)")
    _finish_run(slam, args, publisher)


def _finish_run(slam, args, publisher):
    """Shared epilogue of run and serve: the optional global backends,
    trajectory, ATE, map and visualization dumps, timings."""
    if publisher is not None:
        publisher.close()
    if slam.loop_constraints:
        print(f"loop closures accepted: {len(slam.loop_constraints)}")
    if getattr(args, "pose_graph", False):
        cost = slam.run_pose_graph()
        if cost is not None:
            print(f"pose graph: optimized {slam.map.n_kf} keyframes "
                  f"(final cost {cost:.3e})")
        else:
            print("pose graph: skipped — no verified loop constraints "
                  "(the covisibility/odometry graph is already at its "
                  "optimum; enable --loop-closure to supply measurements)")
    if getattr(args, "global_ba", False):
        cost = slam.run_global_ba()
        if cost is not None:
            print(f"global BA: refined {slam.map.n_kf} keyframes jointly "
                  f"(final cost {cost:.3e})")
        else:
            print("global BA: skipped (map too small)")
    slam.save_trajectory(args.traj_path)
    print(f"trajectory → {args.traj_path}")
    if getattr(args, "gt", None):
        gt = _load_gt(args.gt)
        if gt is None:
            print(f"ground truth not found at {args.gt}")
        else:
            from rspl_slam_tpu_torch.evaluation import absolute_trajectory_error

            t_est, p_est = slam.map.keyframe_trajectory()
            res = absolute_trajectory_error(np.asarray(t_est), np.asarray(p_est)[:, :3, 3],
                                            gt[0], gt[1])
            print("ATE:", json.dumps(res))
    if getattr(args, "save_map", None):
        slam.save_map(args.save_map)
        print(f"map → {args.save_map}")
    if getattr(args, "save_map_text", None):
        slam.map.save_map_text(args.save_map_text)
        print(f"text map → {args.save_map_text}")
    if getattr(args, "viz_dir", None):
        _dump_viz(slam, args.viz_dir)
    _print_timings(slam)


def _dump_viz(slam, viz_dir):
    from rspl_slam_tpu_torch import visualization as viz

    m = slam.map
    pts = m.pt_pos[: m.n_pt][m.pt_status[: m.n_pt] == 2]
    viz.save_ply_points(os.path.join(viz_dir, "mappoints.ply"), pts)
    lns = m.ln_endpoints[: m.n_ln][m.ln_has_endpoints[: m.n_ln]]
    if len(lns):
        viz.save_ply_lines(os.path.join(viz_dir, "maplines.ply"), lns)
    _, poses = m.keyframe_trajectory()
    viz.save_trajectory_png(os.path.join(viz_dir, "trajectory.png"), poses)
    # per-keyframe feature/line overlays from the stored map
    cam = slam.cfg.camera
    for kf in range(m.n_kf):
        if not m.kf_valid[kf]:
            continue
        ov = viz.keyframe_overlay(m, kf, height=cam.image_height, width=cam.image_width)
        viz.save_png(os.path.join(viz_dir, f"kf_{kf:03d}_overlay.png"), ov)
    print(f"visualization → {viz_dir}")


def _print_timings(slam):
    for k, v in sorted(slam.timings.items()):
        print("  %-10s n=%4d median=%6.1f ms" % (k, len(v), np.median(v) * 1e3))
    from rspl_slam_tpu_torch.ops import cuda_build

    # each wrapper counts its kernel's launches (none on the CPU)
    print("kernel launches:", json.dumps(cuda_build.launch_counts()))


def cmd_serve(args):
    """Live stereo ingestion: watch ``<watch-dir>/cam0/data`` and
    ``cam1/data`` for arriving image files, pair them by identical filename
    and feed each pair to the pipelined runner once both halves exist.

    Producers should write-then-rename so a listed file is complete. Stops
    when a file named ``stop`` appears in watch-dir or after
    ``--idle-timeout`` seconds without a new pair, then saves the
    trajectory as ``run`` does.

    Only ``.png``, ``.jpg``, ``.jpeg`` and ``.pgm`` names are taken, the
    JAX package's filter (its ``cli.py``), so half-written temporaries are
    skipped: TIFF, BMP, PFM, GIF and WebP frames, which ``run`` reads, are
    not served."""
    from rspl_slam_tpu_torch.datasets import _load_gray
    from rspl_slam_tpu_torch.pipeline import PipelinedRunner

    slam, cfg = _build_slam(args, use_lines=not args.no_lines)
    compiled = slam.device.type == "cuda"
    publisher = _publisher(args, slam)
    kf_count = [0]

    def on_record(rec, feats):
        if publisher is not None:
            publisher(rec, feats)
        # life-long operation: cull redundant keyframes every N insertions
        if args.cull_every > 0 and rec.is_keyframe:
            kf_count[0] += 1
            if kf_count[0] % args.cull_every == 0:
                n = slam.cull_redundant_keyframes()
                if n:
                    print(f"culled {n} redundant keyframes "
                          f"({int(slam.map.kf_valid[:slam.map.n_kf].sum())} live)")

    runner = PipelinedRunner(slam, queue_depth=cfg.pipeline.queue_depth, on_record=on_record)
    d0 = os.path.join(args.watch_dir, "cam0", "data")
    d1 = os.path.join(args.watch_dir, "cam1", "data")
    stop_file = os.path.join(args.watch_dir, "stop")
    exts = (".png", ".jpg", ".jpeg", ".pgm")

    def _stamp(name: str, idx: int) -> float:
        stem = os.path.splitext(name)[0]
        try:
            return int(stem) * 1e-9  # EuRoC convention: ns in the filename
        except ValueError:
            return idx / 20.0

    def feeder():
        seen: set = set()
        idx = 0
        last_new = time.perf_counter()
        try:
            while True:
                try:
                    names = (set(os.listdir(d0)) & set(os.listdir(d1))) - seen
                except FileNotFoundError:
                    names = set()
                # ingest in time order (unpadded numeric names sort wrongly)
                names = sorted((nm for nm in names if nm.lower().endswith(exts)),
                               key=lambda nm: _stamp(nm, idx))
                fed = False
                for nm in names:
                    runner.feed(idx, _stamp(nm, idx),
                                _load_gray(os.path.join(d0, nm), compiled),
                                _load_gray(os.path.join(d1, nm), compiled))
                    seen.add(nm)
                    idx += 1
                    fed = True
                now = time.perf_counter()
                if fed:
                    last_new = now
                    continue  # drain any backlog before honoring stop/idle
                if os.path.exists(stop_file):
                    break
                if now - last_new > args.idle_timeout:
                    print(f"idle {args.idle_timeout:.0f}s — shutting down")
                    break
                time.sleep(args.poll_ms / 1e3)
        except Exception as e:  # a bad frame must not hang the consumer
            print(f"serve feeder error: {e!r} — shutting down")
        finally:
            runner.close_input()

    print(f"serving: watching {args.watch_dir} (stop file: {stop_file})")
    th = threading.Thread(target=feeder, daemon=True)
    t0 = time.perf_counter()
    th.start()
    records = runner.run_manual()
    th.join()
    wall = time.perf_counter() - t0
    n = len(records)
    print(f"served {n} frames in {wall:.1f}s" + (f" ({n / wall:.1f} fps)" if n else ""))
    _finish_run(slam, args, publisher)


def cmd_eval(args):
    from rspl_slam_tpu_torch.datasets import read_tum_trajectory
    from rspl_slam_tpu_torch.evaluation import absolute_trajectory_error

    t_est, p_est = read_tum_trajectory(args.traj)
    t_gt, p_gt = read_tum_trajectory(args.gt)
    res = absolute_trajectory_error(t_est, p_est[:, :3, 3], t_gt, p_gt[:, :3, 3],
                                    max_dt=args.max_dt)
    print(json.dumps(res, indent=2))


def _gt_csv(path: str):
    rows = np.loadtxt(path, delimiter=",", comments="#", usecols=range(4))
    return rows[:, 0] * 1e-9, rows[:, 1:4]


def _load_gt(path: str):
    """(times, positions) from a ground-truth spec: a sequence directory
    (EuRoC layout), a raw EuRoC csv, or a TUM trajectory file."""
    from rspl_slam_tpu_torch.datasets import read_tum_trajectory

    if os.path.isdir(path):
        return _find_ground_truth(path)
    if not os.path.exists(path):
        return None
    if path.endswith(".csv"):
        return _gt_csv(path)
    t, p = read_tum_trajectory(path)
    return t, p[:, :3, 3]


def _find_ground_truth(seq_dir: str):
    """(times, positions) from ``gt.tum`` or the raw-EuRoC ground-truth csv
    (``mav0/state_groundtruth_estimate0/data.csv``), or None."""
    from rspl_slam_tpu_torch.datasets import read_tum_trajectory

    gt = os.path.join(seq_dir, "gt.tum")
    if os.path.exists(gt):
        t, p = read_tum_trajectory(gt)
        return t, p[:, :3, 3]
    csv = os.path.join(seq_dir, "mav0", "state_groundtruth_estimate0", "data.csv")
    return _gt_csv(csv) if os.path.exists(csv) else None


def cmd_batch(args):
    """Every sequence directory under a root; ONE frontend (the models on
    the device) is shared, only the map state is rebuilt per sequence."""
    from rspl_slam_tpu_torch.datasets import open_dataset, read_tum_trajectory
    from rspl_slam_tpu_torch.evaluation import absolute_trajectory_error
    from rspl_slam_tpu_torch.pipeline import PipelinedRunner
    from rspl_slam_tpu_torch.slam import SLAMSystem

    slam0, cfg = _build_slam(args, use_lines=not args.no_lines)
    frontend = slam0.frontend
    compiled = slam0.device.type == "cuda"
    os.makedirs(args.out_dir, exist_ok=True)
    rows = []
    for seq in sorted(os.listdir(args.root)):
        seq_dir = os.path.join(args.root, seq)
        if not os.path.isdir(seq_dir):
            continue
        try:
            ds = open_dataset(seq_dir, compiled=compiled)
        except FileNotFoundError:
            continue
        n = len(ds) if args.max_frames <= 0 else min(len(ds), args.max_frames)
        print(f"\n=== {seq} ({n} frames)")
        slam = SLAMSystem(cfg, frontend)
        t0 = time.perf_counter()
        PipelinedRunner(slam, ds).run(max_frames=n)
        wall = time.perf_counter() - t0
        print(f"processed {n} frames in {wall:.1f}s ({n / wall:.1f} fps)")
        traj_path = os.path.join(args.out_dir, f"{seq}.txt")
        slam.save_trajectory(traj_path)
        gt = _find_ground_truth(seq_dir)
        if gt is not None:
            t_est, p_est = read_tum_trajectory(traj_path)
            res = absolute_trajectory_error(t_est, p_est[:, :3, 3], gt[0], gt[1])
            rows.append((seq, res["rmse"]))
    print("\nATE RMSE per sequence:")
    for seq, rmse in rows:
        print(f"  {seq:30s} {rmse:.4f} m")


def cmd_synth(args):
    from rspl_slam_tpu_torch.config import PipelineConfig, SuperPointConfig, SystemConfig
    from rspl_slam_tpu_torch.evaluation import absolute_trajectory_error, synthetic
    from rspl_slam_tpu_torch.frontend.frontends import OracleFrontend
    from rspl_slam_tpu_torch.slam import INIT_POSE, SLAMSystem

    cfg = SystemConfig(
        superpoint=SuperPointConfig(max_keypoints=256),
        pipeline=PipelineConfig(ba_max_points=512, ba_max_lines=16),
        use_lines=not args.no_lines)
    scene = synthetic.make_scene(num_points=800, num_lines=12, seed=args.seed,
                                 extent=(10.0, 6.0, 16.0))
    traj = synthetic.make_trajectory(args.frames, step=0.05, yaw_rate=0.004)
    fe = OracleFrontend(cfg, scene, noise_px=0.4, outlier_frac=0.05, seed=args.seed,
                        device=_device(args))
    fe.poses = traj
    slam = SLAMSystem(cfg, fe)
    t0 = time.perf_counter()
    for i in range(args.frames):
        slam.add_frame(i, i * 0.05, None, None)
    wall = time.perf_counter() - t0
    est = np.stack([r.Twc for r in slam.records])
    ts = np.asarray([r.time for r in slam.records])
    gt = np.einsum("ij,njk->nik", INIT_POSE, traj)
    res = absolute_trajectory_error(ts, est[:, :3, 3], ts, gt[:, :3, 3])
    print(f"{args.frames} frames in {wall:.1f}s ({args.frames / wall:.1f} fps)")
    print(f"keyframes={slam.map.n_kf} mappoints={slam.map.n_pt} maplines={slam.map.n_ln}")
    print("ATE:", json.dumps({k: round(v, 5) if isinstance(v, float) else v
                              for k, v in res.items()}))
    if args.traj_path:
        slam.save_trajectory(args.traj_path)
    if args.viz_dir:
        _dump_viz(slam, args.viz_dir)
    _print_timings(slam)


def cmd_pretrain(args):
    """Synthetic pretraining of one of the three networks (``training/``),
    with the JAX CLI's recipes; the trained pytree is written as ``.npz``."""
    from rspl_slam_tpu_torch.models.weights import save_npz_pytree

    dev = _device(args)
    common = dict(steps=args.steps, batch=args.batch, lr=args.lr, seed=args.seed, device=dev)
    if args.model == "superpoint":
        from rspl_slam_tpu_torch.training import superpoint_train

        params = superpoint_train.train(**common)
    elif args.model == "rcf":
        from rspl_slam_tpu_torch.training import rcf_train

        params, _ = rcf_train.train(**common)
    else:
        from rspl_slam_tpu_torch.config import SuperGlueConfig
        from rspl_slam_tpu_torch.training import superglue_train

        cfg = SuperGlueConfig(image_width=320, image_height=240,
                              num_gnn_layers=args.gnn_layers,
                              sinkhorn_iterations=args.sinkhorn_iters)
        params, _ = superglue_train.train(cfg, K=args.keypoints, **common)
    save_npz_pytree(args.output, params)
    print(f"trained {args.model} → {args.output}")


def cmd_convert_weights(args):
    from rspl_slam_tpu_torch.models import rcf, superglue, superpoint
    from rspl_slam_tpu_torch.models.weights import save_npz_pytree

    loaders = {"superpoint": superpoint.load_torch_weights,
               "superglue": superglue.load_torch_weights,
               "rcf": rcf.load_torch_weights}
    params = loaders[args.model](args.input)
    n = save_npz_pytree(args.output, params)
    print(f"{args.model}: {n} arrays → {args.output}")


def _add_device(p):
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the CUDA card; 'cpu' runs the "
                        "plain PyTorch versions of the kernels)")


def main(argv=None):
    p = argparse.ArgumentParser(prog="rspl-slam-torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("run", help="offline dataset run")
    pr.add_argument("--dataroot", required=True)
    pr.add_argument("--config", default=None, help="algorithm yaml")
    pr.add_argument("--camera-config", dest="camera_config", default=None)
    pr.add_argument("--traj-path", dest="traj_path", default="trajectory.txt")
    pr.add_argument("--save-map", dest="save_map", default=None)
    pr.add_argument("--save-map-text", dest="save_map_text", default=None,
                    help="also dump the map in the reference's SaveMap text layout")
    pr.add_argument("--resume-map", dest="resume_map", default=None,
                    help="resume from a saved map checkpoint (npz) instead of "
                         "initializing from scratch")
    pr.add_argument("--viz-dir", dest="viz_dir", default=None)
    pr.add_argument("--max-frames", dest="max_frames", type=int, default=-1)
    pr.add_argument("--no-lines", dest="no_lines", action="store_true")
    pr.add_argument("--serial", action="store_true",
                    help="disable the pipelined runner (strictly serial loop)")
    pr.add_argument("--no-native", dest="no_native", action="store_true",
                    help="read frames through the dataset reader and rectify on the "
                         "device, not on the native prefetcher's C++ decode threads")
    pr.add_argument("--overlay-stride", dest="overlay_stride", type=int, default=1,
                    help="dump a feature overlay every Nth frame")
    pr.add_argument("--sync-ba", dest="sync_ba", action="store_true",
                    help="block tracking on every local BA (default overlaps the "
                         "solve with the following frames)")
    pr.add_argument("--track-local-map", dest="track_local_map", action="store_true",
                    help="recover missed landmark associations by projecting the "
                         "covisible local map into each new keyframe "
                         "(search_by_projection)")
    pr.add_argument("--gt", default=None,
                    help="ground truth (TUM file, EuRoC csv, or sequence dir) — "
                         "prints keyframe ATE after the run")
    pr.add_argument("--sp-weights", dest="sp_weights", default=None,
                    help="SuperPoint checkpoint (.pth/.npz) overriding the config path")
    pr.add_argument("--sg-weights", dest="sg_weights", default=None,
                    help="SuperGlue checkpoint (.pth/.npz)")
    pr.add_argument("--rcf-weights", dest="rcf_weights", default=None,
                    help="RCF checkpoint (.pth/.npz)")
    pr.add_argument("--matcher", choices=["superglue", "cosine"], default="superglue",
                    help="cosine = mutual-NN on descriptors (works with untrained weights)")
    pr.add_argument("--lazy-right", dest="lazy_right", action="store_const", const=True,
                    default=None, help="extract right-image features only at keyframes")
    pr.add_argument("--pose-graph", dest="pose_graph", action="store_true",
                    help="run global pose-graph optimization at the end; needs loop "
                         "constraints — see --loop-closure")
    pr.add_argument("--global-ba", dest="global_ba", action="store_true",
                    help="run full-map bundle adjustment at the end (all keyframes "
                         "and landmarks jointly)")
    pr.add_argument("--loop-closure", dest="loop_closure", action="store_true",
                    help="detect loop closures (place recognition + geometric "
                         "verification) and correct the trajectory via the global "
                         "pose graph; relocalize a lost track")
    pr.add_argument("-v", "--verbose", action="store_true")
    _add_device(pr)
    pr.set_defaults(fn=cmd_run)

    pl = sub.add_parser("serve", help="live stereo ingestion — watch a directory for "
                                      "arriving cam0/cam1 frames")
    pl.add_argument("--watch-dir", dest="watch_dir", required=True,
                    help="directory with cam0/data and cam1/data; frames are "
                         "ingested as both halves of a pair appear")
    pl.add_argument("--config", default=None, help="algorithm yaml")
    pl.add_argument("--camera-config", dest="camera_config", default=None)
    pl.add_argument("--traj-path", dest="traj_path", default="trajectory.txt")
    pl.add_argument("--save-map", dest="save_map", default=None)
    pl.add_argument("--resume-map", dest="resume_map", default=None)
    pl.add_argument("--viz-dir", dest="viz_dir", default=None)
    pl.add_argument("--no-lines", dest="no_lines", action="store_true")
    pl.add_argument("--overlay-stride", dest="overlay_stride", type=int, default=1)
    pl.add_argument("--matcher", choices=["superglue", "cosine"], default="superglue")
    pl.add_argument("--lazy-right", dest="lazy_right", action="store_const", const=True,
                    default=None)
    pl.add_argument("--loop-closure", dest="loop_closure", action="store_true",
                    help="detect loop closures and relocalize a lost track")
    pl.add_argument("--cull-every", dest="cull_every", type=int, default=0,
                    help="life-long mode: cull redundant keyframes every N keyframe "
                         "insertions (0 = never)")
    pl.add_argument("--idle-timeout", dest="idle_timeout", type=float, default=30.0,
                    help="shut down after this many seconds without a new stereo pair")
    pl.add_argument("--poll-ms", dest="poll_ms", type=float, default=20.0)
    _add_device(pl)
    pl.set_defaults(fn=cmd_serve)

    pe = sub.add_parser("eval", help="ATE of estimate vs GT")
    pe.add_argument("--traj", required=True)
    pe.add_argument("--gt", required=True)
    pe.add_argument("--max-dt", dest="max_dt", type=float, default=0.02)
    pe.set_defaults(fn=cmd_eval)

    pb = sub.add_parser("batch", help="batch sequences")
    pb.add_argument("--root", required=True)
    pb.add_argument("--out-dir", dest="out_dir", default="batch_out")
    pb.add_argument("--config", default=None)
    pb.add_argument("--camera-config", dest="camera_config", default=None)
    pb.add_argument("--max-frames", dest="max_frames", type=int, default=-1)
    pb.add_argument("--no-lines", dest="no_lines", action="store_true")
    pb.add_argument("--lazy-right", dest="lazy_right", action="store_const", const=True,
                    default=None)
    _add_device(pb)
    pb.set_defaults(fn=cmd_batch)

    ps = sub.add_parser("synth", help="synthetic sequence with known GT")
    ps.add_argument("--frames", type=int, default=100)
    ps.add_argument("--seed", type=int, default=0)
    ps.add_argument("--no-lines", dest="no_lines", action="store_true")
    ps.add_argument("--traj-path", dest="traj_path", default=None)
    ps.add_argument("--viz-dir", dest="viz_dir", default=None)
    _add_device(ps)
    ps.set_defaults(fn=cmd_synth)

    pt = sub.add_parser("pretrain", help="train SuperPoint / RCF / SuperGlue on synthetic data")
    pt.add_argument("--model", choices=["superpoint", "rcf", "superglue"],
                    default="superpoint")
    pt.add_argument("--steps", type=int, default=300)
    pt.add_argument("--batch", type=int, default=4)
    pt.add_argument("--lr", type=float, default=1e-3)
    pt.add_argument("--gnn-layers", dest="gnn_layers", type=int, default=4,
                    help="superglue only: GNN depth to train")
    pt.add_argument("--sinkhorn-iters", dest="sinkhorn_iters", type=int, default=20,
                    help="superglue only")
    pt.add_argument("--keypoints", type=int, default=64,
                    help="superglue only: keypoints per synthetic problem")
    pt.add_argument("--seed", type=int, default=0)
    pt.add_argument("--output", default="superpoint_synth.npz")
    _add_device(pt)
    pt.set_defaults(fn=cmd_pretrain)

    pc = sub.add_parser("convert-weights", help="torch .pth → .npz pytree")
    pc.add_argument("--model", choices=["superpoint", "superglue", "rcf"], required=True)
    pc.add_argument("--input", required=True)
    pc.add_argument("--output", required=True)
    pc.set_defaults(fn=cmd_convert_weights)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main(sys.argv[1:])
